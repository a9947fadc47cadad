"""The CNN workloads (the paper's three, ResNet-50 v1.5 and ConvNeXt-T) as
plain-data network descriptions."""
from .alexnet import alexnet
from .convnext_t import convnext_t
from .googlenet import googlenet
from .params import infer_shapes, init_network_params, params_from_numpy
from .resnet50 import resnet50
from .squeezenet import squeezenet

WORKLOADS = {"alexnet": alexnet, "squeezenet": squeezenet,
             "googlenet": googlenet, "resnet50": resnet50,
             "convnext_t": convnext_t}

__all__ = ["alexnet", "squeezenet", "googlenet", "resnet50", "convnext_t",
           "infer_shapes", "init_network_params", "params_from_numpy", "WORKLOADS"]
