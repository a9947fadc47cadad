"""GoogLeNet / Inception v1 (Szegedy et al., CVPR 2015) — paper workload #2.

Inception module = four parallel branches (1x1 | 1x1->3x3 | 1x1->5x5 |
maxpool->1x1) concatenated along channels.  Auxiliary classifiers are
omitted (inference-only, as in the paper's deployment).
"""
from __future__ import annotations

from ..core.network import NetworkDescription


def _inception(net: NetworkDescription, name: str, inp: str, c1: int,
               c3r: int, c3: int, c5r: int, c5: int, cp: int) -> str:
    b1 = net.conv(f"{name}_1x1", c1, 1, padding="VALID", inputs=(inp,))
    b1 = net.relu(f"{name}_1x1_relu", inputs=(b1,))
    b3 = net.conv(f"{name}_3x3_reduce", c3r, 1, padding="VALID", inputs=(inp,))
    b3 = net.relu(f"{name}_3x3r_relu", inputs=(b3,))
    b3 = net.conv(f"{name}_3x3", c3, 3, padding="SAME", inputs=(b3,))
    b3 = net.relu(f"{name}_3x3_relu", inputs=(b3,))
    b5 = net.conv(f"{name}_5x5_reduce", c5r, 1, padding="VALID", inputs=(inp,))
    b5 = net.relu(f"{name}_5x5r_relu", inputs=(b5,))
    b5 = net.conv(f"{name}_5x5", c5, 5, padding="SAME", inputs=(b5,))
    b5 = net.relu(f"{name}_5x5_relu", inputs=(b5,))
    bp = net.maxpool(f"{name}_pool", 3, 1, padding="SAME", inputs=(inp,))
    bp = net.conv(f"{name}_pool_proj", cp, 1, padding="VALID", inputs=(bp,))
    bp = net.relu(f"{name}_pool_relu", inputs=(bp,))
    return net.concat(f"{name}_concat", (b1, b3, b5, bp))


def googlenet(scale: float = 1.0, num_classes: int = 1000,
              input_hw: int = 224) -> NetworkDescription:
    c = lambda n: max(int(round(n * scale)), 1)
    net = NetworkDescription("googlenet", (3, input_hw, input_hw))
    net.conv("conv1", c(64), 7, stride=2, padding="SAME", inputs=("input",))
    net.relu("relu1")
    net.maxpool("pool1", 3, 2, padding="SAME")
    net.lrn("norm1")
    net.conv("conv2_reduce", c(64), 1, padding="VALID")
    net.relu("relu2r")
    net.conv("conv2", c(192), 3, padding="SAME")
    net.relu("relu2")
    net.lrn("norm2")
    t = net.maxpool("pool2", 3, 2, padding="SAME")
    t = _inception(net, "inc3a", t, c(64), c(96), c(128), c(16), c(32), c(32))
    t = _inception(net, "inc3b", t, c(128), c(128), c(192), c(32), c(96), c(64))
    t = net.maxpool("pool3", 3, 2, padding="SAME", inputs=(t,))
    t = _inception(net, "inc4a", t, c(192), c(96), c(208), c(16), c(48), c(64))
    t = _inception(net, "inc4b", t, c(160), c(112), c(224), c(24), c(64), c(64))
    t = _inception(net, "inc4c", t, c(128), c(128), c(256), c(24), c(64), c(64))
    t = _inception(net, "inc4d", t, c(112), c(144), c(288), c(32), c(64), c(64))
    t = _inception(net, "inc4e", t, c(256), c(160), c(320), c(32), c(128), c(128))
    t = net.maxpool("pool4", 3, 2, padding="SAME", inputs=(t,))
    t = _inception(net, "inc5a", t, c(256), c(160), c(320), c(32), c(128), c(128))
    t = _inception(net, "inc5b", t, c(384), c(192), c(384), c(48), c(128), c(128))
    net.gap("gap", inputs=(t,))
    net.dense("fc", num_classes)
    net.softmax("prob")
    return net
