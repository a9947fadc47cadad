"""AlexNet (Krizhevsky, Sutskever and Hinton, NeurIPS 2012), single tower.

The benchmark's frozen copy of the network the program serves: the paper's
five convolutions and three dense layers without the two-GPU grouping,
with Caffe's local response normalization (size 5, alpha 1e-4 over the
window's size, beta 0.75, k = 1) after conv1 and conv2, on 227 x 227 x 3.
``scale`` multiplies every width but the classifier's (small CPU tests).
"""
from __future__ import annotations

from .ops import chain


def layers(scale: float = 1.0, num_classes: int = 1000):
    c = lambda n: max(int(round(n * scale)), 1)
    t = []
    lrn = dict(size=5, alpha=1e-4, beta=0.75)
    chain(t, "conv1", "conv", ("input",), out=c(96), k=11, stride=4, padding="VALID")
    chain(t, "relu1", "relu")
    chain(t, "norm1", "lrn", **lrn)
    chain(t, "pool1", "maxpool", pool=3, stride=2, padding="VALID")
    chain(t, "conv2", "conv", out=c(256), k=5, stride=1, padding="SAME")
    chain(t, "relu2", "relu")
    chain(t, "norm2", "lrn", **lrn)
    chain(t, "pool2", "maxpool", pool=3, stride=2, padding="VALID")
    chain(t, "conv3", "conv", out=c(384), k=3, stride=1, padding="SAME")
    chain(t, "relu3", "relu")
    chain(t, "conv4", "conv", out=c(384), k=3, stride=1, padding="SAME")
    chain(t, "relu4", "relu")
    chain(t, "conv5", "conv", out=c(256), k=3, stride=1, padding="SAME")
    chain(t, "relu5", "relu")
    chain(t, "pool5", "maxpool", pool=3, stride=2, padding="VALID")
    chain(t, "flat", "flatten")
    chain(t, "fc6", "dense", out=c(4096))
    chain(t, "relu6", "relu")
    chain(t, "fc7", "dense", out=c(4096))
    chain(t, "relu7", "relu")
    chain(t, "fc8", "dense", out=num_classes)
    chain(t, "prob", "softmax")
    return t
