"""SqueezeNet v1.0 (Iandola et al., 2016) — paper workload #3.

Fire module = squeeze 1x1 conv -> parallel expand 1x1 / 3x3 -> concat: a DAG,
exercising the network-description branching support.
"""
from __future__ import annotations

from ..core.network import NetworkDescription


def _fire(net: NetworkDescription, name: str, inp: str, s1x1: int,
          e1x1: int, e3x3: int) -> str:
    sq = net.conv(f"{name}_squeeze1x1", s1x1, 1, padding="VALID", inputs=(inp,))
    sqr = net.relu(f"{name}_sq_relu", inputs=(sq,))
    e1 = net.conv(f"{name}_expand1x1", e1x1, 1, padding="VALID", inputs=(sqr,))
    e1r = net.relu(f"{name}_e1_relu", inputs=(e1,))
    e3 = net.conv(f"{name}_expand3x3", e3x3, 3, padding="SAME", inputs=(sqr,))
    e3r = net.relu(f"{name}_e3_relu", inputs=(e3,))
    return net.concat(f"{name}_concat", (e1r, e3r))


def squeezenet(scale: float = 1.0, num_classes: int = 1000,
               input_hw: int = 224) -> NetworkDescription:
    c = lambda n: max(int(round(n * scale)), 1)
    net = NetworkDescription("squeezenet", (3, input_hw, input_hw))
    net.conv("conv1", c(96), 7, stride=2, padding="VALID", inputs=("input",))
    net.relu("relu1")
    t = net.maxpool("pool1", 3, 2)
    t = _fire(net, "fire2", t, c(16), c(64), c(64))
    t = _fire(net, "fire3", t, c(16), c(64), c(64))
    t = _fire(net, "fire4", t, c(32), c(128), c(128))
    t = net.maxpool("pool4", 3, 2, inputs=(t,))
    t = _fire(net, "fire5", t, c(32), c(128), c(128))
    t = _fire(net, "fire6", t, c(48), c(192), c(192))
    t = _fire(net, "fire7", t, c(48), c(192), c(192))
    t = _fire(net, "fire8", t, c(64), c(256), c(256))
    t = net.maxpool("pool8", 3, 2, inputs=(t,))
    t = _fire(net, "fire9", t, c(64), c(256), c(256))
    t = net.conv("conv10", num_classes, 1, padding="VALID", inputs=(t,))
    net.relu("relu10")
    net.gap("gap")
    net.softmax("prob")
    return net
