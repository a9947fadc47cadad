"""AlexNet (Krizhevsky et al., NeurIPS 2012) — paper workload #1.

Single-tower variant (the standard inference form).  ``scale`` shrinks
channel counts for CPU-sized tests while preserving the layer structure.
"""
from __future__ import annotations

from ..core.network import NetworkDescription


def alexnet(scale: float = 1.0, num_classes: int = 1000,
            input_hw: int = 227) -> NetworkDescription:
    c = lambda n: max(int(round(n * scale)), 1)
    net = NetworkDescription("alexnet", (3, input_hw, input_hw))
    net.conv("conv1", c(96), 11, stride=4, padding="VALID", inputs=("input",))
    net.relu("relu1")
    net.lrn("norm1", size=5)
    net.maxpool("pool1", 3, 2)
    net.conv("conv2", c(256), 5, padding="SAME")
    net.relu("relu2")
    net.lrn("norm2", size=5)
    net.maxpool("pool2", 3, 2)
    net.conv("conv3", c(384), 3, padding="SAME")
    net.relu("relu3")
    net.conv("conv4", c(384), 3, padding="SAME")
    net.relu("relu4")
    net.conv("conv5", c(256), 3, padding="SAME")
    net.relu("relu5")
    net.maxpool("pool5", 3, 2)
    net.flatten("flat")
    net.dense("fc6", c(4096))
    net.relu("relu6")
    net.dense("fc7", c(4096))
    net.relu("relu7")
    net.dense("fc8", num_classes)
    net.softmax("prob")
    return net
