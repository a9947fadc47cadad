"""The CNN workloads (the paper's three and ResNet-50 v1.5) as plain-data
network descriptions."""
from .alexnet import alexnet
from .googlenet import googlenet
from .params import infer_shapes, init_network_params, params_from_numpy
from .resnet50 import resnet50
from .squeezenet import squeezenet

WORKLOADS = {"alexnet": alexnet, "squeezenet": squeezenet,
             "googlenet": googlenet, "resnet50": resnet50}

__all__ = ["alexnet", "squeezenet", "googlenet", "resnet50", "infer_shapes",
           "init_network_params", "params_from_numpy", "WORKLOADS"]
